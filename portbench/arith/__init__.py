"""The yardstick's arithmetic: the card's peaks, the least time of a
kernel's work, and the model FLOPs of a training step."""
