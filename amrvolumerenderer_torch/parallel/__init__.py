"""Multi-device sort-last compositing (``directsend``)."""
