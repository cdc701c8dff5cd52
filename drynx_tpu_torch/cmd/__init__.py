"""Command-line entry points of the port: `python -m drynx_tpu_torch.cmd.
server` boots a node, `python -m drynx_tpu_torch.cmd.client` builds the
roster and survey configs and runs surveys."""
