"""Synthetic data — port of ``repro/data``: the Zipf-Markov training corpus."""
