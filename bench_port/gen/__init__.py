"""Region generators: ``gen/<name>.py`` defines ``pool(config, mix, seed)``,
which returns the cell's pool of regions drawn from ``seed`` alone."""
