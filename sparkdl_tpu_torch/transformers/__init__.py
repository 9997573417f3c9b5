"""The batched inference loop shared by the port's transformers."""
