from portbench.readers import sample_ms as read  # noqa: F401
