"""PyTorch + CUDA port of implicit_depth_tpu for NVIDIA Hopper (H100)."""
