"""Training of the port: view selection, the task forward pass, the loss's
train step and the optimiser."""
