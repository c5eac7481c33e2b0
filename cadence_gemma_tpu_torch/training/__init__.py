"""SFT training of the port's Griffin: loss, steps, optimizer, data, loop."""
