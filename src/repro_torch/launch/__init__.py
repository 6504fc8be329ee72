"""Process-group setup and the distributed KRR driver of the port."""
