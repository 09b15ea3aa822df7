"""In-process wire-level fakes of external services (a Kafka broker, a
MongoDB server) and the fault injectors of the resilience tests
(``faults``)."""
