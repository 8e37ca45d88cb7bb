"""Cohort orchestration of the port: incubator, group assembly, device waves."""
