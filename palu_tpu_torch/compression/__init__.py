"""The compression path (port of palu_tpu/compression): rank search,
whitening and Fisher calibration, and the G-LRD decomposition of the k/v
projections."""

from .calibration import get_calib_batches, synthetic_batches  # noqa: F401
from .compress import compress_params, kv_module_names, search_ranks  # noqa: F401
from .fisher import calib_fisher_info, fisher_group_means  # noqa: F401
from .rank_search import rank_search, rounding_search_result, split_values  # noqa: F401
from .whiten import whiten_scale_matrices  # noqa: F401
