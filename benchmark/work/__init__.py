"""The work the benchmark counts itself: the networks' FLOPs from their
published layer lists, the flow kernel's bytes and instructions from its
shapes, and the card's published peaks.  Nothing here reads the program."""
