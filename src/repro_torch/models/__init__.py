"""Models of the port: the dense decoder path and the site-aware compute
wrappers (``compute``) through which the kernels are injected."""
