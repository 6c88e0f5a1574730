"""NLP models and serving of the port (counterpart of
``paddle_tpu/nlp``): GPT, its loss and its serving engine so far."""
from .convert import load_numpy_state  # noqa: F401
from .gpt import (GPT_CONFIGS, GPTConfig, GPTForCausalLM,  # noqa: F401
                  GPTModel, GPTPretrainingCriterion)
from .serving import ServeRequest, ServingEngine  # noqa: F401
