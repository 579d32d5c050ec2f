"""Serving: the continuous-batching scheduler over the paged KV pool
(``scheduler.py``) and the serve loop and CLI (``serve.py``)."""
