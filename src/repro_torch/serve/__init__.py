"""Serving helpers of the port's LM: batched prefill and KV-cache decode
(``serving``)."""
