from .gpt2 import GPT2Config, GPT2LMHeadModel  # noqa: F401
from .llama import LlamaConfig, LlamaForCausalLM  # noqa: F401
from .mixtral import MixtralConfig, MixtralForCausalLM  # noqa: F401
