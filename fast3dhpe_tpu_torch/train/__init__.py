"""Train state, optimizer and the train/eval steps of the port."""
