"""Port of the palu_tpu.parallel package: device meshes over
torch.distributed (mesh.py) and process bootstrap (multihost.py). The
sequence-parallel decode that runs on a ("data", "seq") mesh lives in
ops/attention.py and runtime/engine.py; tensor parallelism over a "model"
axis and the pipeline (parallel/pipeline.py) come with later slices."""

from .mesh import axis_group, make_mesh, world_size  # noqa: F401
from .multihost import (default_backend, host_local_batch_slice,  # noqa: F401
                        initialize_multihost, make_pod_mesh)
