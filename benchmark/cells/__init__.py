"""The loops that drive a cell, one module a traffic mix's "kind"
(benchmark/cells/<kind>.py, class Cell), found by that name."""
