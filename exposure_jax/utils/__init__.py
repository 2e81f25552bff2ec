from exposure_jax.utils.config import load_config, load_config_file
from exposure_jax.utils.dict_util import Dict, merge_dict
from exposure_jax.utils.logging_util import MedianWindow, MetricLogger, Tee
from exposure_jax.utils.ops import (
    STATE_REWARD_DIM,
    STATE_STOPPED_DIM,
    STATE_STEP_DIM,
    STATE_DROPOUT_BEGIN,
    lerp,
    lrelu,
    rgb2lum,
    tanh01,
    tanh_range,
)
