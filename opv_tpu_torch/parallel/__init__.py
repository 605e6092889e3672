"""Multi-device execution of the port (counterpart of opv_tpu/parallel/):
meshes of torch devices, the channel-, time- and grid-sharded feed-forward
receiver, and the multi-process bootstrap."""

from opv_tpu_torch.parallel.mesh import make_mesh, channel_mesh
from opv_tpu_torch.parallel.sharded import rx_fast_sharded, rx_time_sharded
from opv_tpu_torch.parallel.grid import rx_grid_sharded
from opv_tpu_torch.parallel.multihost import initialize_multihost, global_mesh

__all__ = ["make_mesh", "channel_mesh", "rx_fast_sharded", "rx_time_sharded",
           "rx_grid_sharded", "initialize_multihost", "global_mesh"]
