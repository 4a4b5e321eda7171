"""OpenViVQA on PyTorch and CUDA: the port of ``openvivqa_tpu`` to an NVIDIA
H100, beside the JAX package, which stays the reference.

Layers (each mirrors its ``openvivqa_tpu`` counterpart):
  config.py, registry.py, logging_utils.py, utils/, data/, evaluation/
                      - the host layers, the port's own copies
  builders.py         - the port's registries and build functions
  ops/                - hand-written CUDA kernels (csrc/) beside plain versions
  models/             - torch nn.Modules for the ported architectures
  training/           - optimizer, losses, checkpoints and tasks
  train.py            - the command line entry point
The port imports torch and never jax, nor anything of ``openvivqa_tpu``.
"""

__version__ = "0.1.0"
