"""Models of the port (counterpart of paddle_tpu.models): LLaMA serving and training."""
from .convert import llama_from_numpy, llama_to_numpy, name_map  # noqa: F401
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,  # noqa: F401
                    LlamaPretrainingCriterion)
from .llama_decode import LlamaDecodeEngine  # noqa: F401
