"""Prophesee / COCO detection metrics (numpy copies of the JAX package's)."""
from rvt_tpu_torch.evaluation.prophesee import (PropheseeEvaluator,
                                                evaluate_list)
