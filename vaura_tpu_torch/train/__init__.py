"""Training: optimizer and state (``state``), train and eval steps (``steps``)."""
