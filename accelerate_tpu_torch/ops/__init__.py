"""Device ops of the port: the paged-decode kernel wrapper and KV quantization."""
