"""NVIDIA H100 SXM5 80GB (700 W) constants, per GPU, for the roofline model.

Nothing here is a TPU figure.  Sources:

* dense BF16 tensor-core peak 989 TFLOP/s (the data sheet's 1,979 is with
  sparsity) and HBM3 3.35 TB/s: NVIDIA H100 Tensor Core GPU data sheet,
  https://resources.nvidia.com/en-us-tensor-core/nvidia-tensor-core-gpu-datasheet
* NVLink 4: 900 GB/s a GPU, 450 GB/s a direction, between the 8 GPUs of
  a node (NVSwitch): the same data sheet, and the DGX H100 user guide,
  https://docs.nvidia.com/dgx/dgxh100-user-guide/introduction-to-dgxh100.html
* across nodes: one ConnectX-7 NDR400 InfiniBand port a GPU, 400 Gb/s =
  50 GB/s: the DGX H100 user guide, above.
"""

PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense tensor cores
HBM_BW = 3.35e12                # bytes/s
NVLINK_BW = 450e9               # bytes/s a direction, within a node
NET_BW = 50e9                   # bytes/s a GPU across nodes (NDR400)

GPUS_PER_NODE = 8
