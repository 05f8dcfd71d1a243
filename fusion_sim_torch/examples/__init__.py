"""Runnable examples of the port
(``python -m fusion_sim_torch.examples.<name>``)."""
