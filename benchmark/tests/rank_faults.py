"""Faults that every rank of the four-card cell plants
(drivers/train_dp.py `Cell.plant`), each taking a setter as faults.py's
do. A rank loads this file by its path, so it imports nothing of the
benchmark."""


def ranks_step_alone(put):
    """Each rank steps on its own rows: the gradients' all_reduce is left
    out, so the ranks' weights part after the first update."""
    from fast3dhpe_tpu_torch.train import steps
    put(steps, "_sync_grads", lambda mesh, state: None)
