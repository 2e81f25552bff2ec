from exposure_jax.data.provider import DataProvider
from exposure_jax.data.fivek import FiveKDataProvider
from exposure_jax.data.artist import ArtistDataProvider
from exposure_jax.data.folder import FolderDataProvider
from exposure_jax.data.synthetic import SyntheticDataProvider
from exposure_jax.data.folds import read_set
from exposure_jax.data.device_sampler import DevicePack, sample_batch
