"""NLP models and serving of the port (counterpart of
``paddle_tpu/nlp``): GPT (serving, training and ``generate()``) with its
serving engine, BERT/ERNIE pretraining, and Llama (``generate()``) so
far."""
from .bert import (BERT_CONFIGS, BertConfig, BertForPretraining,  # noqa: F401
                   BertModel, BertPretrainingCriterion)
from .convert import load_numpy_state  # noqa: F401
from .ernie import (ERNIE_CONFIGS, ErnieConfig,  # noqa: F401
                    ErnieForPretraining, ErnieModel,
                    ErniePretrainingCriterion)
from .generation import generate  # noqa: F401
from .gpt import (GPT_CONFIGS, GPTConfig, GPTForCausalLM,  # noqa: F401
                  GPTModel, GPTPretrainingCriterion)
from .llama import (LLAMA_CONFIGS, LlamaConfig,  # noqa: F401
                    LlamaForCausalLM, LlamaModel, LlamaPretrainingCriterion)
from .serving import ServeRequest, ServingEngine  # noqa: F401
