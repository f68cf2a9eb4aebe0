"""Device ms a step of the volumetric unprojection's bilinear sampling,
forward and backward: the kernels that geometry/volume.py unproject's
F.grid_sample launches. With align_corners=True, zero padding and fp32
on an H100 that is cuDNN's sampler (`cudnn::bilinear_sampler_fw_4d`,
`cudnn::bilinear_sampler_bw_4d`); ATen's own (`grid_sampler_2d_kernel`,
`grid_sampler_2d_backward_kernel`) where cuDNN does not take it. None
where no such kernel ran."""

UNPROJECT = ("bilinear_sampler_", "grid_sampler_2d")


def read(trace):
    if trace.count(*UNPROJECT) == 0:
        return None
    return 1e3 * trace.kernel_s(*UNPROJECT) / trace.steps
