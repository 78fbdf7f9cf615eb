"""Measurement tools of the port: ``profile_device`` (where an arm step's
time goes on the card) and ``long_window_stats`` (whether LONG windows
would fit a device tile class); ``timing`` holds what they share with
``hypo_tpu_torch.bench``."""
