"""Inference: the serving engine and its replicated fabric
(``inference.llm``), and the str/int/bytes serving surface over them
(``inference.serving``)."""
