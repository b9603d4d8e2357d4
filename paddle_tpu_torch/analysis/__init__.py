"""Analysis tools of the port (counterpart of paddle_tpu.analysis): the
fault-injection harness the serving resilience drills run on, the runtime
sanitizers (graftsan) and numsan's device-side finiteness check."""
from . import faultinject, sanitizers  # noqa: F401
