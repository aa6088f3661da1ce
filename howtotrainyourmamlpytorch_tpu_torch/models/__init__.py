"""The few-shot backbone (``vgg``)."""
