"""Models of the port (counterpart of paddle_tpu.models): LLaMA serving and training."""
from .convert import llama_from_numpy, llama_to_numpy, name_map  # noqa: F401
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,  # noqa: F401
                    LlamaPretrainingCriterion)
from .llama_decode import LlamaDecodeEngine  # noqa: F401
from .radix_cache import PrefixCache  # noqa: F401
from .serving import (AdmissionTimeout, ContinuousBatchingEngine,  # noqa: F401
                      RequestAborted, RequestShed, StaticBatchEngine)
from .spec_decode import SuffixDrafter  # noqa: F401
