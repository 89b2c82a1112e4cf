"""Model families and text datasets of the port: ``gpt``, ``bert`` and
``datasets`` (``paddle.text``)."""
from . import bert, datasets, gpt
from .bert import BertConfig, BertForSequenceClassification, BertModel
from .datasets import (WMT14, WMT16, Conll05st, Imdb, Imikolov, Movielens,
                       UCIHousing, ViterbiDecoder, viterbi_decode)
from .gpt import GPTConfig, GPTForCausalLM, GPTModel
