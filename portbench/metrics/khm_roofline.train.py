from portbench.readers import khm_roofline as read  # noqa: F401
