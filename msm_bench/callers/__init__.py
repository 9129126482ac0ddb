"""How a cell's calls reach the program: callers/<name>.py, named by the
traffic's `caller`, defines Caller(config, points, pool, device) with
call(sets) -> one affine (x, y) a set, in order.  points is the fixed
bases' wire bytes; pool the scalar sets' wire bytes."""
