"""PyTorch/CUDA port of painter_tpu: in-context ViT serving on NVIDIA GPUs."""
