"""Probes of the kernels on the card (run_probes.py): what bounds them."""
