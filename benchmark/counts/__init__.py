"""The yardstick's arithmetic: operations and bytes of each kernel and of a
step or a tile, and the H100's published peaks.  Frozen copies, so that a
change to the program cannot move them."""
