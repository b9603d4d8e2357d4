"""Analysis tools of the port (counterpart of paddle_tpu.analysis): the
fault-injection harness the serving resilience drills run on."""
from . import faultinject  # noqa: F401
