"""Hand-written Hopper kernels of the port, each beside its plain-PyTorch
twin and a launch counter.  Sources live in ``gordo_tpu_torch/csrc``;
:mod:`gordo_tpu_torch.kernels.build` compiles them at first use."""
