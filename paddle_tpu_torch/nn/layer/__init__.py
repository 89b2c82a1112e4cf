"""Paddle's layers as ``torch.nn.Module`` subclasses."""
