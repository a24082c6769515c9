"""One module per kind of timed path; a traffic file names its driver."""
