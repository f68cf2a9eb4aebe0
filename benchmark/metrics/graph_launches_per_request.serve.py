"""CUDA graph replays a request (cudaGraphLaunch calls in the window): 0
where the request runs every kernel eagerly."""


def read(trace):
    return trace.launches.get("cudaGraphLaunch", 0) / trace.steps
