"""Launchers of the port (counterpart of ``repro.launch``): the LLM train
step (``steps``) and its command line (``train``)."""
