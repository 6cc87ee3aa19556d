"""PyTorch + CUDA port of metal_pathtracer_tpu for NVIDIA Hopper."""
