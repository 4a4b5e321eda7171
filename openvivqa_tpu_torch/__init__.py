"""OpenViVQA on PyTorch and CUDA: the port of ``openvivqa_tpu`` to an NVIDIA
H100, beside the JAX package, which stays the reference.

Layers (each mirrors its ``openvivqa_tpu`` counterpart):
  builders.py         - the port's ARCHITECTURE and TASK registries
  ops/                - hand-written CUDA kernels (csrc/) beside plain versions
  models/             - torch nn.Modules for the ported architectures
  training/tasks/     - eval tasks over the shared host layers
The host layers (config, registry, data, evaluation) are imported from
``openvivqa_tpu``, which loads them without JAX.
"""

__version__ = "0.1.0"
