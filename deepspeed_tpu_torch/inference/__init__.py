"""Serving: token choice (``generation``) and the v2 ragged engine (``v2``)."""
