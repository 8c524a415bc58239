"""The host-side data layer: batch types, HDF5 recording readers, stream
schedulers, the parallel loader and prefetching (copies of the JAX
package's)."""
from rvt_tpu_torch.data.types import Batch, DatasetSamplingMode
