from portbench.readers import conv_ms_per_iter as read  # noqa: F401
