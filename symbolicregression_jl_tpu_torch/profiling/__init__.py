"""Profiling instruments of the port: counterparts of the repo's ``profiling/``
scripts that reach a kernel (``kernel_variants``: kernel #1's A/B structure
variants on the card)."""
