"""The benchmark's plain reference: the models, the sampler and the train
step in plain PyTorch, in float32 with TF32 off, or in emulated fp8 for the
control.

Written from the architectures' equations, independently of the program:
nothing here imports ``rectified_flow_vision_tpu_torch`` (or JAX), and no
weight, table or random draw is taken from it. The modules carry the
program's state-dict names only so that one set of weights, made by the
benchmark from the seed, loads into both sides.
"""
