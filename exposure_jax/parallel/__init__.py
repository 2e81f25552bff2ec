from exposure_jax.parallel.mesh import data_parallel_mesh, local_batch_size
