"""PyTorch and CUDA port of cerberusnet_tpu for NVIDIA Hopper GPUs.

The joint CerberusNet forward (shared pyramid encoder; disparity, flow and
segmentation heads) with hand-written CUDA correlation kernels. The JAX
package ``cerberusnet_tpu`` is the reference it is held against; this
package imports nothing of it, nor of JAX.
"""
