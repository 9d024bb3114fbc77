"""Command-line demos of the port (counterparts of the repository's
scripts/inference_setup.py and scripts/images/*.py), run as
`python -m behindthescenes_tpu_torch.scripts.<name>`."""
