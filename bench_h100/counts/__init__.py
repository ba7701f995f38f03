"""The yardstick's arithmetic: the table of peaks, the least time of a
sampler call from the bytes and operations its inputs need
(:mod:`.taps`), and the model's FLOPs (:mod:`.flops`)."""
