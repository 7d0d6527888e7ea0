"""Serving: the batched prefill + decode engine."""
