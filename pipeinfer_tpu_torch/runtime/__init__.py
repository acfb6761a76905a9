"""KV cell cache and the decode engine (InferenceContext)."""
