"""Operators of the PyTorch port: ``nn`` and ``tensor`` (bound to the op
names of ``registry``), the optimizer rules of ``_optim_kernels``, and the
hand-written Hopper ``kernels``."""
