"""Training runtime: config, engine, schedules, loss scaling."""
