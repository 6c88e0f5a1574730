"""NLP models and serving of the port (counterpart of
``paddle_tpu/nlp``): GPT and its serving engine so far."""
from .convert import load_numpy_state  # noqa: F401
from .gpt import (GPT_CONFIGS, GPTConfig, GPTForCausalLM,  # noqa: F401
                  GPTModel)
from .serving import ServeRequest, ServingEngine  # noqa: F401
