"""The Paddle-API core of the port: dtypes, devices, random state, the
``Tensor`` surface, autograd entry points and the op registry."""
