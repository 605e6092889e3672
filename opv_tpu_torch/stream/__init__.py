"""The streaming receivers of the port: LockedStreamDemodulator (the
multichannel engine), MultiChannelDemodulator (the feed-forward dense
receiver in overlapped blocks), WidebandReceiver (channelizer + either
engine), the reference-parity tracking receivers StreamingDemodulator and
MultiChannelTrackingDemodulator, and their checkpoint files."""

from opv_tpu_torch.stream.chunked import StreamingDemodulator
from opv_tpu_torch.stream.locked import LockedStreamDemodulator
from opv_tpu_torch.stream.multichannel import MultiChannelDemodulator
from opv_tpu_torch.stream.state import load_state, save_state
from opv_tpu_torch.stream.tracking import MultiChannelTrackingDemodulator
from opv_tpu_torch.stream.wideband import WidebandReceiver

__all__ = ["StreamingDemodulator", "LockedStreamDemodulator",
           "MultiChannelDemodulator",
           "MultiChannelTrackingDemodulator", "WidebandReceiver",
           "save_state", "load_state"]
