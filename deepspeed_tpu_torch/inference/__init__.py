"""Serving: token choice and the v1 loop (``generation``), the v1 engine (``engine``,
``config``), weight-only quantisation (``quantization``) and the v2 ragged engine (``v2``)."""
