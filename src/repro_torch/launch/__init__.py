"""Step builders for the port: prefill and greedy serve steps."""
