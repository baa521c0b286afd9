"""Layout helpers the reference keeps beside its step builders."""
