"""The yardstick's counts: peaks of the card, the convolutions' operations
and the kernels' least bytes and operations, all from shapes."""
