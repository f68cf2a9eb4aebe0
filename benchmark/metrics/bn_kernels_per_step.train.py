"""Train-mode BatchNorm kernels a step: the device kernels whose names hold
train_bn_ (fast3dhpe_tpu_torch/csrc/batchnorm.cu, three launches a layer
each way) over the window's steps; 0 where train BN runs as eager ATen
kernels."""

KERNEL = "train_bn_"


def read(trace):
    return trace.count(KERNEL) / trace.steps
