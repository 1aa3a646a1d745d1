"""The transformer-LM recipe (``main_amp.py``)."""
