from portbench.readers import launches_per_iter as read  # noqa: F401
