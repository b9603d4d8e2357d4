"""Models of the port (counterpart of paddle_tpu.models): the LLaMA serving slice."""
from .convert import llama_from_numpy  # noqa: F401
from .llama import LlamaConfig, LlamaForCausalLM, LlamaModel  # noqa: F401
from .llama_decode import LlamaDecodeEngine  # noqa: F401
