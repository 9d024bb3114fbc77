"""Models of the port: the monodepth2 encoder, the field MLPs and BTSNet."""
