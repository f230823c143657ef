"""Model families of the port (llama first) and their shared pieces."""
