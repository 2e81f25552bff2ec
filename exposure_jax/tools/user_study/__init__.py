from exposure_jax.tools.user_study.filters import all_filters
from exposure_jax.tools.user_study.session import RetouchSession
