"""Request-level robustness of the port: the request deadline."""
