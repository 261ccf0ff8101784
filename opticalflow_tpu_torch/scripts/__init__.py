"""Probes of the port's kernels on the card, counterparts of the JAX
package's ``scripts/probe_*.py``."""
