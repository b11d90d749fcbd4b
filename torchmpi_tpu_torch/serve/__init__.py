"""torchmpi_tpu_torch.serve — inference serving over the parameter server.

The port of ``torchmpi_tpu/serve``: servers answer inference requests
from a weight snapshot (:class:`WeightCache`) while a background downpour
group keeps training and publishing updates through the parameter
server; a refresher thread fetches fresh weights and swaps them in by
version vector, so a weight refresh never pauses serving. The snapshot
and the request's input live on the parameter server's device, and
``model_fn`` runs there.

Degradation is a ladder, not a cliff (:func:`brownout_level`): under
queue pressure a server first sheds its lowest-QoS requests with a
retry-after hint, then widens the weight-refresh staleness bound. The
REQUEST/REPLY frames of the PS socket transport, the supervisor's scale
rungs and the serving example wait for ROADMAP A13 and A10; here
:meth:`InferenceServer.handle` is called in process (or by any transport
given to the server).
"""

from .client import ServeClient, ShedError
from .server import InferenceServer, brownout_level, shed_qos_floor
from .weights import WeightCache, version_vector

__all__ = [
    "InferenceServer",
    "ServeClient",
    "ShedError",
    "WeightCache",
    "brownout_level",
    "shed_qos_floor",
    "version_vector",
]
