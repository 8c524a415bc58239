"""Host-side batch types and prefetching (copies of the JAX package's)."""
from rvt_tpu_torch.data.types import Batch, DatasetSamplingMode
