from exposure_jax.ops.color_space import hsv_to_rgb, rgb_to_hsv
from exposure_jax.ops.filters import (
    ColorFilter,
    ContrastFilter,
    ExposureFilter,
    Filter,
    GammaFilter,
    ImprovedWhiteBalanceFilter,
    LevelFilter,
    SaturationPlusFilter,
    ToneFilter,
    VignetFilter,
    WNBFilter,
    max_filter_parameters,
)
from exposure_jax.ops.sampling import pdf_sample
