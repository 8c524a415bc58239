"""Data parallelism over processes (``torch.distributed``): the port's
counterpart of ``rvt_tpu/parallel/``."""
from rvt_tpu_torch.parallel.mesh import (DataParallel, init_process_group,
                                         make_mesh, replicate_tree)
from rvt_tpu_torch.parallel.multihost import (allgather_bytes,
                                              is_main_process,
                                              merge_evaluator_buffers)
