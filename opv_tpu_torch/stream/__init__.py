"""The streaming receivers of the port: LockedStreamDemodulator (the
multichannel engine, on one device or a mesh's 'ch' shards),
MultiChannelDemodulator (the feed-forward dense receiver in overlapped
blocks), ShardedStreamDemodulator (the dense receiver over a (ch, time)
mesh in rolling windows), WidebandReceiver (channelizer + either engine),
the reference-parity tracking receivers StreamingDemodulator and
MultiChannelTrackingDemodulator, and their checkpoint files."""

from opv_tpu_torch.stream.chunked import StreamingDemodulator
from opv_tpu_torch.stream.locked import LockedStreamDemodulator
from opv_tpu_torch.stream.multichannel import MultiChannelDemodulator
from opv_tpu_torch.stream.sharded import ShardedStreamDemodulator
from opv_tpu_torch.stream.state import load_state, save_state
from opv_tpu_torch.stream.tracking import MultiChannelTrackingDemodulator
from opv_tpu_torch.stream.wideband import WidebandReceiver

__all__ = ["StreamingDemodulator", "LockedStreamDemodulator",
           "MultiChannelDemodulator", "ShardedStreamDemodulator",
           "MultiChannelTrackingDemodulator", "WidebandReceiver",
           "save_state", "load_state"]
