"""Serving: continuous batching scheduler + HTTP server
(ref: examples/server/server.cpp slots, examples/parallel/parallel.cpp
cont_batching :238-311). Torch counterpart of pipeinfer_tpu.serving."""
