"""The BERT family (counterpart of ``paddle_tpu/text/bert.py``):
``BertConfig`` (``base()`` is BERT-base, ``tiny()`` a narrow test
size), ``BertEmbeddings``, ``BertPooler``, ``BertModel`` and
``BertForSequenceClassification``, on the port's
``nn.TransformerEncoder`` (post-LN).

- ``hidden_act="gelu"`` is the exact erf GELU (``F.gelu``'s default),
  where GPT uses the tanh form;
- positions are ``arange(S)`` on the ids' device, with no offset;
- ``attention_mask`` goes to the encoder unchanged: a boolean keep-mask
  or an additive float mask, ``[B, 1, 1, S]`` or any shape that
  broadcasts to the scores ``[B, heads, S, S]``. With a mask, or with
  attention dropout in training, the attention takes the plain float32
  route (the dropout kernel on the probabilities); without either, the
  flash kernels where the head size allows.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import nn

__all__ = ["BertConfig", "BertEmbeddings", "BertPooler", "BertModel",
           "BertForSequenceClassification"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02

    @staticmethod
    def base():
        return BertConfig()

    @staticmethod
    def tiny():
        return BertConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                          num_attention_heads=4, intermediate_size=128,
                          max_position_embeddings=128)


class BertEmbeddings(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            x = x + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(x))


class BertPooler(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[:, 0]))


class BertModel(nn.Layer):
    """Returns ``(sequence_output [B, S, H], pooled [B, H])``."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg)
        layer = nn.TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout_prob, activation=cfg.hidden_act,
            attn_dropout=cfg.attention_probs_dropout_prob)
        self.encoder = nn.TransformerEncoder(layer, cfg.num_hidden_layers)
        self.pooler = BertPooler(cfg)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids)
        seq = self.encoder(x, attention_mask)
        return seq, self.pooler(seq)


class BertForSequenceClassification(nn.Layer):
    def __init__(self, cfg: BertConfig, num_classes=2):
        super().__init__()
        self.bert = BertModel(cfg)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)
        self.classifier = nn.Linear(cfg.hidden_size, num_classes)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled))
