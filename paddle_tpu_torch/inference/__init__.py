"""Inference: the serving engine (``inference.llm``)."""
