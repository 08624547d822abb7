"""Host control plane: call control, command processing and the
operator's TCP command server (``control.server``).

The reference's PMT message-port topology (SURVEY.md §3.2) becomes
explicit host-side wiring: the RECC decoder output feeds
``BaseStation.handle_burst``; operator text commands feed
``BaseStation.handle_command``; outputs are word injections into the
FOCC/FVC streams plus mute toggles for the voice path.
"""

from amps_tpu_torch.control.fields import RxWordA, RxWordB, RxWordC, RxWordCalled  # noqa: F401
from amps_tpu_torch.control.station import BaseStation, StationEvent  # noqa: F401
