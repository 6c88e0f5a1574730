"""NLP models and serving of the port (counterpart of
``paddle_tpu/nlp``): GPT (serving and training) with its serving engine,
and BERT/ERNIE pretraining so far."""
from .bert import (BERT_CONFIGS, BertConfig, BertForPretraining,  # noqa: F401
                   BertModel, BertPretrainingCriterion)
from .convert import load_numpy_state  # noqa: F401
from .ernie import (ERNIE_CONFIGS, ErnieConfig,  # noqa: F401
                    ErnieForPretraining, ErnieModel,
                    ErniePretrainingCriterion)
from .gpt import (GPT_CONFIGS, GPTConfig, GPTForCausalLM,  # noqa: F401
                  GPTModel, GPTPretrainingCriterion)
from .serving import ServeRequest, ServingEngine  # noqa: F401
