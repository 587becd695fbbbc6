from portbench.readers import head_roofline as read  # noqa: F401
