"""The optimizer (AdamW) and the gradient compression of the port."""
