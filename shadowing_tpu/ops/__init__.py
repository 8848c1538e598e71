"""Search ops: exact tournament top-k, sliding correlations, the factored
two-pass search (:mod:`~shadowing_tpu.ops.factored`) and the named matmul
precisions (:mod:`~shadowing_tpu.ops.precision`)."""
from shadowing_tpu.ops.sliding import sliding_dot
from shadowing_tpu.ops.topk import (
    TopKResult,
    merge_min,
    topk_min,
    topk_min_checked,
    topk_min_sort,
)
