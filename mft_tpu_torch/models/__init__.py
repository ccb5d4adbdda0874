"""Models of the port: the RAFT-OU optical flow network."""
