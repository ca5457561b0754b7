"""The elastic launcher (stop-resume) and the job-environment contract."""
